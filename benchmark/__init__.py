"""The port's benchmark (see BENCHMARK.json at the repository root)."""
