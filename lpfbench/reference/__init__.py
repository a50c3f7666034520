"""Plain references of the benchmark's cells, in PyTorch alone: nothing
of the program under test (``repro_torch``) and nothing of the JAX
package is imported here, and nothing the program made is read except
the outputs being judged."""
