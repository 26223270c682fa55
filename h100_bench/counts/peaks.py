"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W), as chip_smoke.py:193-196 has them."""

PEAK_FP32_FLOPS = 67e12          # fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12         # TF32 on the tensor cores, dense
PEAK_BYTES_PER_S = 3.35e12       # HBM3
