"""charon_tpu_torch.core — the duty workflow.

Copies of the JAX package's core modules: `types`, `interfaces` (the
component Protocols and `wire()`), `scheduler`, `fetcher`, `leadercast`
(the in-process cluster's consensus), `dutydb`, `validatorapi`,
`parsigdb`, `parsigex`, `aggsigdb`, `bcast`, and the two device call
sites, `verify.BatchVerifier` and `sigagg.SigAgg`, wired to this
package's `tbls.dispatch`.
"""
