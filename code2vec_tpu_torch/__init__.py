"""code2vec in PyTorch for NVIDIA Hopper: the port of `code2vec_tpu`.

It serves a release artifact written by either package. The device work
of the serving path runs in hand-written CUDA kernels (`kernels/`), each
beside its plain PyTorch version. The package imports nothing of JAX or
of `code2vec_tpu`; importing it loads no kernel and needs no GPU.
"""
