"""Scripts that time edited copies of the port's CUDA kernels on one card
(``python3 -m tools.<script>`` from the repo's root)."""
