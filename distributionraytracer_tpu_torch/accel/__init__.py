"""Acceleration structures: host-built grid and BVH tables and the packet
traversal kernels K7 (grouped walk), K8 (threaded walk) and K9 (binned
primary rays)."""
