from femcy_tpu_torch.utils.timing import Timer, device_trace

__all__ = ["Timer", "device_trace"]
