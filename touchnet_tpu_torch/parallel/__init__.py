# Parallel layers of the port. Only the single-device path of the fused
# linear + cross-entropy is ported; meshes come with the multi-device slice.
