"""code2vec in PyTorch for NVIDIA Hopper: the port of `code2vec_tpu`.

It trains the model, serves a release artifact written by either package
and runs code search over it (embed, index-build, /neighbors). The device
work of those paths runs in hand-written CUDA kernels (`kernels/`), each
beside its plain PyTorch version. The package imports nothing of JAX or
of `code2vec_tpu`; importing it loads no kernel and needs no GPU.
"""
