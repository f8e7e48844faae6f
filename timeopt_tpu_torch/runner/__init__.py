"""The port's suite runner (run_suite.py)."""
