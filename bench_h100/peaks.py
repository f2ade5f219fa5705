"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W):
the yardstick of every roofline share and MFU here."""

#: bf16 FLOP/s in the tensor cores
BF16_FLOPS = 989e12
#: f32 FLOP/s outside the tensor cores (an FMA counts two)
F32_FLOPS = 67e12
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
#: device memory, bytes
CARD_BYTES = 80e9
