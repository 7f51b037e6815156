"""Host runtime: native queue bindings + the threaded pipeline
(the array-native src/main threading topology, SURVEY.md §1)."""
