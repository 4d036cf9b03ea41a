"""Point-cloud operators: k-NN (K1), filters, outliers, minimizers, ICP (K2)."""
