"""Model definitions of the port beside the paper's MLP (`core.gan`):
the convolutional generator for image-valued parameter spaces
(`convgen`, counterpart of `repro.models.convgen`), and the LLM stack of
the serving path: `config` (`ModelConfig`), `layers`, `blocks` and
`model` (dense decoders: prefill, decode, forward), counterparts of the
modules of the same names in `repro.models`."""
