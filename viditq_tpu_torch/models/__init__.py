"""STDiT and its layers."""
