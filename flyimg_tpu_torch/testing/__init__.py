"""Test support: deterministic fault injection for the serving pipeline
(``flyimg_tpu_torch.testing.faults``). Nothing here acts unless an injector
is installed, by a test or through the server's ``fault_injector``
parameter."""
