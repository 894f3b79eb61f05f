"""The benchmark's tests: CPU tests of the harness, the references and
the yardstick, and tests marked ``card`` that run on the card."""
