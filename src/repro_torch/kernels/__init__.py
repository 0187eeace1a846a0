"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(`ref`) and the builder that compiles `csrc/` at first use (`build`).

Ported: `inverse_cdf` (the Pallas `_icdf_kernel` of
`repro.kernels.inverse_cdf`), `imaging` (`_mask_kernel` and
`_blur_kernel` of `repro.kernels.imaging`) and `flash_attention`
(`_flash_kernel` of `repro.kernels.flash_attention`, forward).  Still to
port: the SSD scan (ROADMAP.md queue B).
"""
