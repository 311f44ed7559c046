"""The CoRL2017 benchmark."""
