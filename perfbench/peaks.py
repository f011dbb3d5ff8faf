"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit), against which a share of a peak or a roofline is
stated."""

# HBM3 bytes a second
PEAK_BYTES = 3.35e12
# FLOP a second: float32 outside the tensor cores, TF32 and bf16 on them
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
# 32-bit integer operations a second: 64 INT32 lanes per SM against 128
# float32 lanes that count 2 FLOP per FMA
PEAK_INT32 = PEAK_F32 / 4
