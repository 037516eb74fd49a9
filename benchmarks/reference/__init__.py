"""Plain PyTorch references of what the benchmark's cells compute. They
import nothing of the program or of JAX, and work out again from the seed
what the program derives from it (weights, batch orders, noise)."""
