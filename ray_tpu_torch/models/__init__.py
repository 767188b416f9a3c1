"""Model families of the port (the Llama decoder)."""
