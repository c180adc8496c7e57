// The bf16 instances of flash.cuh's flash_fwd_kernel, one per head
// dim and tile.
#include "flash.cuh"

FLASH_LAUNCHER(fwd, bf16, kFwd, __nv_bfloat16)
