"""The paper's contribution on torch: IR, featurizers, fusion, NAS space,
executor + profiler on the card, tree predictors and composition."""
