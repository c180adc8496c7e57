// The bf16 instances of flash.cuh's flash_bwd_dkdv_kernel, one per head
// dim and tile.
#include "flash.cuh"

FLASH_LAUNCHER(dkdv, bf16, kDkdv, __nv_bfloat16)
