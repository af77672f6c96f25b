"""Data-preparation command lines of the port."""
