"""The CARNOVEL benchmark."""
