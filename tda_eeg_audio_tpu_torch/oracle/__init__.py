"""Host oracles of the port's tests (numpy / scipy, no device code): exact
Rips persistence, the reference's scipy signal chain and persim's diagram
Wasserstein.  Copies of the reference package's `oracle/` modules, kept
here so that the port imports nothing of that package."""
