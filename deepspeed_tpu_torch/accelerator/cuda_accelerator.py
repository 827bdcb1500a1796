"""The CUDA accelerator (counterpart of ``deepspeed_tpu/accelerator/tpu_accelerator.py``)."""

from .abstract_accelerator import DeepSpeedAccelerator


class CUDA_Accelerator(DeepSpeedAccelerator):
    name = "cuda"

    def devices(self):
        import torch

        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    def current_device(self):
        import torch

        return torch.device("cuda", torch.cuda.current_device())

    def device_name(self, device_index=None):
        import torch

        return torch.cuda.get_device_name(device_index or 0)

    def synchronize(self, device_index=None):
        import torch

        torch.cuda.synchronize(device_index)

    def memory_stats(self, device_index=None):
        import torch

        if not torch.cuda.is_available():
            return {}
        index = device_index or 0
        return {
            "bytes_in_use": torch.cuda.memory_allocated(index),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(index),
            "bytes_reserved": torch.cuda.memory_reserved(index),
            "bytes_limit": torch.cuda.get_device_properties(index).total_memory,
        }

    def empty_cache(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def communication_backend_name(self):
        return "nccl"
