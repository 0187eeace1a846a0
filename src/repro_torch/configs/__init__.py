"""Presets of the port: the solve service's `DEFAULT` and `REDUCED`
(`serving`), as in `repro.configs.serving`."""
