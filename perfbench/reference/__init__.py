"""Plain float32 references the benchmark holds the program to: one file
an architecture, AdamW, and the layer-at-a-time training loop. They
import nothing of the program."""
