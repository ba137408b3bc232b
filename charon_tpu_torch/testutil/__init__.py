"""Test utilities: beaconmock, validatormock, cluster fabrication.

Mirrors the reference's testutil package strategy (reference: testutil/):
real components are driven by in-process fakes rather than mocks, so every
integration test exercises production code paths.  Copies of the JAX
package's modules of the same names."""
