"""The renderer's benchmark (run.py); see README.md."""
