from .attention import attend_plain, decode_attend, decode_attend_plain
from .cuda import KERNELS, build_all, launch_counts, reset_launch_counts
from .flash import flash_attention

__all__ = ["attend_plain", "decode_attend", "decode_attend_plain",
           "flash_attention", "KERNELS", "build_all", "launch_counts",
           "reset_launch_counts"]
