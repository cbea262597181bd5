"""The plain float32 references the benchmark holds the program to: one
module a model family (``dense`` now), each with its parameter
layout (``param_spec``), its loss over a block of rows (``nll_sum``) and
its model FLOPs a step (``model_flops``); ``adamw`` and ``train`` (the
first steps of training, in blocks of rows). Plain PyTorch: nothing here
imports the program, and nothing takes what the program has made."""
