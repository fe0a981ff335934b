"""`flash_attention_roofline.prefill_mla`: the sm90 flash kernel's (192,
128) instance's share of its roofline (`portbench.prefill_layers.
kernel_roofline`, least time from `roofline/prefill_mla.
flash_least_seconds`)."""
from portbench.prefill_layers import FLASH, kernel_roofline
from portbench.roofline import prefill_mla


def read(reading):
    return kernel_roofline(reading, FLASH, "flash_attention",
                           prefill_mla.flash_least_seconds)
