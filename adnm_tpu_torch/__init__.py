"""PyTorch port of adnm_tpu for NVIDIA Hopper (H100).

Mirrors the module layout of ``adnm_tpu`` (the JAX reference, which stays
beside it): ``ops`` (kernels and their plain versions), ``core`` (layers,
wavelets, blocks), ``mixers``, ``models``, ``convert`` (weights from the
JAX parameter tree) and ``cli``. Tensors are NCHW throughout. Importing
this package imports neither JAX nor ``adnm_tpu``.
"""
