"""Generators of the benchmark's inputs."""
