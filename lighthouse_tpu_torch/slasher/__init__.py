"""Slasher — twin of slasher/ (+service): detects slashable messages."""

from .slasher import Slasher, SlasherConfig  # noqa: F401
