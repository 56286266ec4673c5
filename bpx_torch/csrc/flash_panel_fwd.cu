// The flash forward's panel builds (flash_common.cuh): bf16 at every head
// dim from 1 to 256 that the tabled kernels do not take, on the narrow, wide
// and tall kernels of flash_fwd.cu at the head dim's panel width with the
// head dim a runtime argument (bpx_flash_panel_fwd).  A translation unit of
// its own, so that nvcc builds it beside the tabled instantiations.
#define BPX_FLASH_PANEL 1
#include "flash_fwd.cu"
