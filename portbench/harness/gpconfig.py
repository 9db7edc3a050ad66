"""The port's GPConfig of a configuration file's "gp" entry."""

from __future__ import annotations


def gp_config(config: dict):
    from madaiemulator_tpu_torch.utils.config import CovarianceFamily, GPConfig

    kw = dict(config["gp"])
    kw["covariance"] = CovarianceFamily(kw["covariance"])
    return GPConfig(**kw)
