"""The H100's published peaks, frozen for the benchmark.

NVIDIA H100 SXM5 80GB data sheet, dense rates (no sparsity) at the SXM
part's 700 W. The port keeps its own copies (`launch/rooftool.py`), which
a later change may edit; these stay as they are. A card whose power limit
is below 700 W runs below them: the run records the limit beside the
shares.
"""

#: Dense TF32 on the tensor cores: the highest rate at which the tensor
#: cores take float32 inputs, so no float32-accurate path can pass it.
PEAK_FLOPS = 495e12
#: Float32 outside the tensor cores, and three TF32 passes (3xTF32), the
#: port's float32-accurate flash forward: for comparison in PERF.md.
PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_3XTF32 = PEAK_FLOPS / 3
#: HBM3 bandwidth.
HBM_BYTES_PER_S = 3.35e12
#: The power limit the peaks assume.
POWER_LIMIT_W = 700.0
