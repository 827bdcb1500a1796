"""Small shared helpers of the PyTorch port."""

# The port goes slice by slice (ROADMAP.md queue A). A feature the JAX
# package has and the port does not yet raises through ``not_ported``, so a
# config or call that asks for it never runs silently without it.
ROADMAP_ITEMS = {
    "A.2": "serving core: ServingEngine, paged KV pool, paged_flash_decode",
    "A.3": "serving fleet and observability: router, telemetry, health, monitors",
    "A.4": "weight-only quantization and the int8 KV pool (ported)",
    "A.5": "checkpoints and importers: load_checkpoint, module_inject",
    "A.7": "distribution: tensor/expert/pipeline/sequence parallelism, ZeRO, MoE",
    "A.8": "offload: ZeRO-Offload and ZeRO-Infinity to host memory and NVMe",
    "A.9": "the rest: encoders, banded local attention, audits",
    "A.10": "block-sparse attention and its kernels (ported; nothing raises this item)",
}


def not_ported(what, item):
    """The ``NotImplementedError`` for a feature that waits for ROADMAP ``item``."""
    return NotImplementedError(
        f"{what} is not ported to deepspeed_tpu_torch yet "
        f"(ROADMAP.md {item}: {ROADMAP_ITEMS[item]})")
