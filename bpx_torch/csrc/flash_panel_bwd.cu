// The flash backward's panel builds (flash_common.cuh): bf16 at every head
// dim from 1 to 256 that the tabled kernels do not take, on the narrow, wide
// and split kernels of flash_bwd.cu at the head dim's panel width with the
// head dim a runtime argument (bpx_flash_panel_bwd), and delta on its own
// (bpx_flash_panel_delta).  A translation unit of its own, so that nvcc
// builds it beside the tabled instantiations.
#define BPX_FLASH_PANEL 1
#include "flash_bwd.cu"
