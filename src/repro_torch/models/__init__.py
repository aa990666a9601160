"""Model stack of the port: layers, MoE, the decoder stack and the facade."""
