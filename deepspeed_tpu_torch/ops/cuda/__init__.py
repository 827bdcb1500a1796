"""Hand-written CUDA kernels of the port and their wrappers.

``LAUNCH_COUNTS`` holds one plain integer per kernel; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show which
kernels its main path went through.
"""

LAUNCH_COUNTS = {"flash_attention_fwd": 0}


def reset_launch_counts():
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
