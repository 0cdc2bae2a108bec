"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit): operations or bytes per second."""

PEAK = {
    "int8": 1979e12,
    "fp8": 1979e12,
    "bf16": 989e12,
    "tf32": 495e12,
    "fp32": 67e12,
}
HBM_BYTES_PER_S = 3.35e12
