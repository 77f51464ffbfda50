"""Training: configs (config.py), synthetic data (data.py), logs
(logger.py), the trainer (trainer.py) and the entry point (run.py).

This module imports nothing itself: the data module's worker processes
import only numpy.
"""
