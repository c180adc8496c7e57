// The fp32 instances of flash.cuh's flash_bwd_dq_kernel, one per head
// dim and tile.
#include "flash.cuh"

FLASH_LAUNCHER(dq, f32, kDq, float)
