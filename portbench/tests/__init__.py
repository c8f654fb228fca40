"""portbench's tests (CPU, and `card`-marked ones for one CUDA GPU)."""
