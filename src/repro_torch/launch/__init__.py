"""Launchers: planning against the card's memory and the training CLI."""
