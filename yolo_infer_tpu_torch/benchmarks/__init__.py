"""Speed benchmarks of the port (`speed_benchmark.SpeedBenchmark`)."""
