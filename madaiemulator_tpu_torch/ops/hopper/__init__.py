"""Hand-written Hopper (sm_90a) kernels, one module per TPU kernel they
replace: `pairwise` (K1), `cholesky` (K2) and `panel` (K3). Each module
holds the wrapper that launches its kernel, the plain-PyTorch version the
wrapper runs on CPU tensors, and a launch counter. `build` compiles `csrc/`
at first use."""
