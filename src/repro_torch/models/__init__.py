"""Model definitions of the port beside the paper's MLP (`core.gan`):
the convolutional generator for image-valued parameter spaces
(`convgen`), counterpart of `repro.models.convgen`."""
