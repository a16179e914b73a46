"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W): operations per second by type, and HBM bytes per second."""

PEAKS = {
    "fp32": 67e12,
    "tf32": 495e12,
    "bf16": 989e12,
    "hbm_bytes": 3.35e12,
}
