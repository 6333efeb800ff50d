"""Plain PyTorch references of the benchmark's configurations. They import
nothing of the port: they take the benchmark's inputs (graph, weights,
draws) and work out again whatever the port derives from them."""
