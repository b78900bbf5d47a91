"""Inference oracles of the port: HMC (the paper's MCMC stand-in)."""
from repro_torch.inference.hmc import hmc_sample

__all__ = ["hmc_sample"]
