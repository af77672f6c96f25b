"""Reinforcement-learning blocks: SCST."""
