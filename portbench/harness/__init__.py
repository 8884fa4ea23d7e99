"""The general loops, inputs, arithmetic and trace reading of the benchmark."""
