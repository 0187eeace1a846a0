"""Solver core of the port: the `proxy1d` forward model (`pipeline`),
the Eq. 6 residuals (`residuals`), the generators (`gan`: the MLP, and
the dispatch to `models.convgen`) and the solve factory (`workflow`).
Counterpart of `repro.core`; the training half (discriminator, exchange
engine, drivers) is not ported yet."""
