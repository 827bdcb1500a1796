"""Hand-written CUDA kernels of the port and their wrappers.

``LAUNCH_COUNTS`` holds one plain integer per kernel; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show which
kernels its main path went through. The kernels with two routes count every
launch under their name (``flash_attention_{fwd,bwd}``,
``quantized_matmul_int{8,4}``, ``fused_ce_forward``,
``block_sparse_attention_{fwd,bwd}``) and those of their TMA + wgmma route
also under the name with ``_wgmma``; the quantized matmul's decode route
also under ``quantized_matmul_int{8,4}_mma``.
"""

LAUNCH_COUNTS = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                 "flash_attention_fwd_wgmma": 0, "flash_attention_bwd_wgmma": 0,
                 "fused_ce_forward": 0, "fused_ce_forward_wgmma": 0,
                 "paged_flash_decode": 0, "paged_flash_decode_int8": 0,
                 "quantized_matmul_int8": 0, "quantized_matmul_int4": 0,
                 "quantized_matmul_int8_wgmma": 0, "quantized_matmul_int4_wgmma": 0,
                 "quantized_matmul_int8_mma": 0, "quantized_matmul_int4_mma": 0,
                 "block_sparse_attention_fwd": 0, "block_sparse_attention_bwd": 0,
                 "block_sparse_attention_fwd_wgmma": 0, "block_sparse_attention_bwd_wgmma": 0}


# the routes of the kernels with two: TMA + wgmma, and the warp-level wmma
# kernels that take every shape the kernel takes
ROUTES = ("wgmma", "wmma")


def resolve_route(kernel, auto, route, inputs):
    """The route a wrapper launches: ``auto``, its route function's answer
    for the inputs (None where no route takes them), unless ``route`` forces
    one, to time one route against the other in one process. A forced route
    the inputs (described by ``inputs``) cannot take raises."""
    if route is None:
        return auto
    if route not in ROUTES:
        raise ValueError(f"{kernel}: unknown route {route!r} (routes {ROUTES})")
    if auto is None or (route == "wgmma" and auto != "wgmma"):
        raise ValueError(f"{kernel}: route {route!r} does not take {inputs} (its route is "
                         f"{auto!r})")
    return route


def reset_launch_counts():
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
