"""The inference pipeline: dataset -> partition -> embeddings -> bundle."""
