"""The benchmark's harness: manifest, traffic, the job loop, the trace."""
