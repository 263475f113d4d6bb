"""CPU tests of the benchmark harness (python3 -m pytest gdfbench/tests)."""
