"""The benchmark's plain reference of FusionOcc: plain PyTorch, no kernels,
nothing of the port or of the JAX package.  ``fusion_occ.FusionOcc`` is the
model, ``optim.train_step`` one training step, ``weights.make_weights`` the
seeded weights both sides are given."""
