"""The plain reference the benchmark holds the port to: the LIO step
(``lio``), its surfel map (``surfels``), the keyframe pose graph's solve
(``pgo``) and the keyframes' voxels (``geometry``), written from the
configurations' definitions in PyTorch; nothing of the port is imported."""
