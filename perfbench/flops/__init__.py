"""The model FLOP counts, written once from the configuration's widths."""
