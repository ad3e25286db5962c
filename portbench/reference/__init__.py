"""The plain reference: what the port has to produce, worked out again from the inputs with NumPy and hashlib."""
