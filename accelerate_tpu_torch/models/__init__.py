"""Model families of the port: ``llama`` and the shared generation driver."""
