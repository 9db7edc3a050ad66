"""Batched ensembles of independent emulators (port of
madaiemulator_tpu/parallel/): `ensemble` fits and serves E scalar GPs at
once, every (member x restart) lane in one lock-step batch on one GPU."""
