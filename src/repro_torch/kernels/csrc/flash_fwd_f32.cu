// The fp32 instances of flash.cuh's flash_fwd_kernel, one per head
// dim and tile.
#include "flash.cuh"

FLASH_LAUNCHER(fwd, f32, kFwd, float)
