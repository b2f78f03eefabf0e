from femcy_tpu_torch.native.loader import build_pattern_native, get_lib
