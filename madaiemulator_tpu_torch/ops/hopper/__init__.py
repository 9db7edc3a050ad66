"""Hand-written Hopper (sm_90a) kernels, one module per TPU kernel they
replace: `pairwise` (K1) and `cholesky` (K2). Each module holds the wrapper
that launches its kernel, the plain-PyTorch version the wrapper runs on CPU
tensors, and a launch counter. `build` compiles `csrc/` at first use."""
