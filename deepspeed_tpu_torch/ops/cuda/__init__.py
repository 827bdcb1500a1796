"""Hand-written CUDA kernels of the port and their wrappers.

``LAUNCH_COUNTS`` holds one plain integer per kernel; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show which
kernels its main path went through. The flash kernels and the quantized
matmul count every launch under their name (``flash_attention_{fwd,bwd}``,
``quantized_matmul_int{8,4}``) and those of their TMA + wgmma route also
under the name with ``_wgmma``.
"""

LAUNCH_COUNTS = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                 "flash_attention_fwd_wgmma": 0, "flash_attention_bwd_wgmma": 0,
                 "fused_ce_forward": 0,
                 "paged_flash_decode": 0, "paged_flash_decode_int8": 0,
                 "quantized_matmul_int8": 0, "quantized_matmul_int4": 0,
                 "quantized_matmul_int8_wgmma": 0, "quantized_matmul_int4_wgmma": 0,
                 "block_sparse_attention_fwd": 0, "block_sparse_attention_bwd": 0}


def reset_launch_counts():
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
