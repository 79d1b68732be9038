"""Tests of the renderer (run with python -m pytest tests/)."""
