"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(`ref`) and the builder that compiles `csrc/` at first use (`build`).

Ported, every Pallas kernel of `repro.kernels`: `inverse_cdf`
(`_icdf_kernel` of `repro.kernels.inverse_cdf`), `imaging` (`_mask_kernel`
and `_blur_kernel` of `repro.kernels.imaging`), `flash_attention`
(`_flash_kernel` of `repro.kernels.flash_attention`) and `ssd_scan`
(`_ssd_kernel` of `repro.kernels.ssd_scan`).  Each wrapper is a
`torch.autograd.Function` with the JAX package's backward.  Flash
attention and the SSD scan take bf16 through tensor-core kernels
(`csrc/*_tc.cu`, bf16 wgmma fed by TMA, with `csrc/hopper.cuh`) and fp32
through FMA kernels; the dtype picks the route.
"""
