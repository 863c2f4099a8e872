"""Drivers: how a traffic mix drives the port (``traffic/<mix>.json`` names one)."""
