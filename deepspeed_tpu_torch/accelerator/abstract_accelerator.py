"""Accelerator abstraction (port of ``deepspeed_tpu/accelerator/abstract_accelerator.py``).

The pluggable-platform seam: device enumeration and resolution, memory
statistics, synchronization and the communication-backend name. Under
PyTorch a device is a ``torch.device``.
"""

import abc


class DeepSpeedAccelerator(abc.ABC):
    name: str = ""

    # ---- device management ----------------------------------------------------
    @abc.abstractmethod
    def devices(self):
        """All addressable accelerator devices (``torch.device`` list)."""

    def device_count(self):
        return len(self.devices())

    @abc.abstractmethod
    def current_device(self):
        """The default ``torch.device`` of this process."""

    @abc.abstractmethod
    def device_name(self, device_index=None):
        """Human-readable device kind (e.g. 'NVIDIA H100 80GB HBM3')."""

    def is_available(self):
        return self.device_count() > 0

    def resolve_device(self, device=None):
        """The ``torch.device`` an entry point runs on: the accelerator unless
        the caller names another device (``"cpu"`` in the tests). With no
        accelerator and no explicit device this raises — an entry point never
        falls back to the CPU on its own."""
        import torch

        if device is None:
            if not self.is_available():
                raise RuntimeError(
                    f"no {self.name} device is available; pass device='cpu' to "
                    "run the port on the CPU")
            return self.current_device()
        device = torch.device(device)
        if device.type == self.name and not self.is_available():
            raise RuntimeError(f"device {device} requested but no {self.name} device is available")
        return device

    # ---- synchronization ------------------------------------------------------
    @abc.abstractmethod
    def synchronize(self, device_index=None):
        """Block until all queued work on the device has finished."""

    # ---- memory ---------------------------------------------------------------
    @abc.abstractmethod
    def memory_stats(self, device_index=None):
        """dict with at least bytes_in_use / bytes_limit when the platform
        reports them (empty dict otherwise)."""

    def empty_cache(self):
        """Release cached, unused device memory."""

    # ---- communication backend ------------------------------------------------
    @abc.abstractmethod
    def communication_backend_name(self):
        """What ``torch.distributed.init_process_group`` brings up."""
