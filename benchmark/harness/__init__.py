"""The benchmark's harness: manifest, traffic, weights, the serving cells'
runner, the correctness check and the trace readings."""
