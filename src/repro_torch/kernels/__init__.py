"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the device dispatch (``ops``)."""
