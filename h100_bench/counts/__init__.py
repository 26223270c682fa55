"""Frozen operation and byte counts, the yardstick of the roofline and MFU
shares. Each counts the work the inputs need, whatever implements it."""
