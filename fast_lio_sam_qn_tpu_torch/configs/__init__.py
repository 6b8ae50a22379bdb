"""Dataset presets (``presets.py``)."""
