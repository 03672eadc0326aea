"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W):
989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in fp32 outside them,
3.35 TB/s of HBM."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
