"""Dense decoder model of the port: config, layers, block stack, facade."""
