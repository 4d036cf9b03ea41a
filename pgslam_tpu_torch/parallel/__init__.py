"""The fleet and the multi-device layer: batched registration, N agents
over one pose graph, and a (dp, tp) device mesh with the sharded full
registration (``multichip``, ``sharded_icp``)."""
