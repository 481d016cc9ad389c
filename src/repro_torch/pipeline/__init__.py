"""The pipeline: dataset -> partition -> local training (or seeded
inference) -> pooled embeddings -> classifier -> serving bundle."""
