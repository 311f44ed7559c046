"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A card set below that limit runs
slower under load: every result prints the card's power limit beside its
shares of these peaks."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12   # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
