// The bf16 instances of flash.cuh's flash_bwd_dq_kernel, one per head
// dim and tile.
#include "flash.cuh"

FLASH_LAUNCHER(dq, bf16, kDq, __nv_bfloat16)
