"""The benchmark's CPU tests (and its control, on the card)."""
