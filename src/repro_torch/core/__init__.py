"""Solver core of the port, counterpart of `repro.core`: the `proxy1d`
forward model (`pipeline`), the Eq. 6 residuals (`residuals`), the GAN
networks (`gan`: the generators, with the dispatch to `models.convgen`,
and the discriminator), the exchange engine (`ring`, `sync`), the solve
and the training loop (`workflow`), the ensemble response (`ensemble`)
and the tree helpers they share (`tree`)."""
