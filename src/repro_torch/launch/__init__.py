"""Launchers: planning against the card's memory, and the training and
serving CLIs."""
