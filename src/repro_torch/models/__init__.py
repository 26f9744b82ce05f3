"""Model zoo of the port: the dense decoder LM."""
