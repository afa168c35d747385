"""Measurement scripts run on the card (not imported by the port)."""
