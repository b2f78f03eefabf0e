from femcy_tpu_torch.utils.timing import Timer

__all__ = ["Timer"]
