"""Parameter declarations for the LM stack (`rules.py`)."""
