"""Integrations of the port with other front ends: the ``%%sql`` IPython
magic (`ipython.py`) and the FugueSQL engine adapter (`fugue.py`)."""
