"""The fast-simulation serving engine: sample, route, decode, expm1."""

from zdcsim_torch.inference.engine import FastSim  # noqa: F401
