// The fp32 instances of flash.cuh's flash_bwd_dkdv_kernel, one per head
// dim and tile.
#include "flash.cuh"

FLASH_LAUNCHER(dkdv, f32, kDkdv, float)
